"""Generate the PyTorch port's surrogate-workflow notebooks under notebooks/.

The reference ships its offline training as two Jupyter notebooks
(experiments/supercell_kessler_surrogate/jupyter_notebooks/
kessler_netcdf_to_numpy.ipynb and kessler_singlecell_train_example.ipynb);
``scripts/make_notebooks.py`` writes the JAX package's equivalents, and this
script writes the same walkthrough on ``miniweatherml_tpu_torch``: the same
cells, with the port's ``ml`` calls and tensors on a device taken from
``MWML_DEVICE`` (default ``cuda``; ``cpu`` runs them without a GPU), and a
last cell that deploys the exported model through
``experiments/inference_surrogate.py::surrogate_from_config``.  Cell ids are
fixed, so the output is the same on every run.  Regenerate after editing:

    python scripts/make_torch_notebooks.py
"""

from __future__ import annotations

import os

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "notebooks")


def notebook(name, cells):
    nb = nbf.v4.new_notebook()
    nb.cells = [
        nbf.v4.new_markdown_cell(src) if kind == "md"
        else nbf.v4.new_code_cell(src)
        for kind, src in cells
    ]
    for i, cell in enumerate(nb.cells):
        cell["id"] = f"{name}-{i}"
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3"}
    return nb


_PATH_SETUP = """\
# Make the repo importable when running from notebooks/ without an install.
for p in (os.path.abspath(".."), os.path.abspath(".")):
    if (os.path.isdir(os.path.join(p, "miniweatherml_tpu_torch"))
            and p not in sys.path):
        sys.path.insert(0, p)"""


CURATE = [
    ("md", """\
# Kessler surrogate data: NetCDF → NumPy curation (PyTorch port)

Equivalent of the reference's `kessler_netcdf_to_numpy.ipynb`
(`experiments/supercell_kessler_surrogate/jupyter_notebooks/`) on
`miniweatherml_tpu_torch`: collect the per-task NetCDF files written by the
`generate_micro_data` experiment, merge and shuffle them, and save a single
`.npz` the training notebook consumes.

Harvest a dataset first (or use the small sample shipped at the repo root):

```
python -m miniweatherml_tpu_torch generate_micro_data \\
    inputs/surrogate_example.yaml [--device cpu]
```

Each file holds `inputs (nsamples, 5, 2)` float32 — five coupler variables
[temp, rho_d, rho_v, rho_c, rho_p] at the cell and the cell above (the
second stencil row packs temp/rho_v/rho_c/rho_p, skipping the rho_d row,
exactly like the reference's `generate_micro_surrogate_data.h:137-140`) —
and `outputs (nsamples, 4)` [temp, rho_v, rho_c, rho_p] after Kessler,
plus grid metadata scalars."""),
    ("code", f"""\
import glob, os, sys

{_PATH_SETUP}

import numpy as np

from miniweatherml_tpu_torch.ml.surrogate_data import load_dataset

# Point this at the directory holding supercell_kessler_data_task_*.nc
# (the repo root ships a small sample).
data_dir = os.environ.get(
    "MWML_DATA_DIR",
    ".." if glob.glob("../supercell_kessler_data_task_*.nc") else ".")
files = sorted(glob.glob(os.path.join(data_dir, "supercell_kessler_data_task_*.nc")))
print(f"{{len(files)}} task file(s):", files)"""),
    ("code", """\
all_in, all_out, meta = [], [], {}
for f in files:
    inputs, outputs, meta = load_dataset(f)
    print(f"{os.path.basename(f)}: inputs {inputs.shape}, outputs {outputs.shape}")
    all_in.append(inputs)
    all_out.append(outputs)
inputs = np.concatenate(all_in, axis=0)
outputs = np.concatenate(all_out, axis=0)
print("merged:", inputs.shape, outputs.shape)
print("metadata:", meta)"""),
    ("code", """\
# Shuffle once with a fixed seed so train/val splits are reproducible.
rng = np.random.default_rng(0)
perm = rng.permutation(inputs.shape[0])
inputs, outputs = inputs[perm], outputs[perm]

out_path = os.path.join(data_dir, "kessler_dataset.npz")
np.savez(out_path, inputs=inputs, outputs=outputs,
         **{k: np.float64(v) for k, v in meta.items()})
print("wrote", out_path)"""),
    ("md", """\
The `.npz` is accepted anywhere a harvest `.nc` is
(`miniweatherml_tpu_torch.ml.surrogate_data.load_dataset` reads both)."""),
]


TRAIN = [
    ("md", """\
# Kessler single-cell surrogate: training example (PyTorch port)

Equivalent of the reference's `kessler_singlecell_train_example.ipynb` on
`miniweatherml_tpu_torch`: train the 5 → 10 → 4 LeakyReLU(0.1) MLP (Nadam,
MSE, 10 epochs, batch 1024, validation split 0.2, min-max normalization) on
harvested Kessler input→output pairs, export weights + scaling tables, and
deploy them in the online surrogate microphysics
(`physics/kessler_surrogate.py`, the ponni-runtime equivalent).

The trainer is `miniweatherml_tpu_torch.ml.train` — this notebook is the
interactive walkthrough of the same calls.  It runs on the device named by
`MWML_DEVICE` (default `cuda`; `cpu` runs it without a GPU)."""),
    ("code", f"""\
import os, sys
import numpy as np
import torch

{_PATH_SETUP}

from miniweatherml_tpu_torch.experiments.driver import checked_device
from miniweatherml_tpu_torch.ml.surrogate_data import load_dataset
from miniweatherml_tpu_torch.ml.train import train_mlp, normalize, denormalize

device = checked_device("notebook", os.environ.get("MWML_DEVICE", "cuda"))

# A curated .npz from torch_kessler_netcdf_to_numpy.ipynb, or a raw harvest
# .nc (the small sample shipped at the repo root works for a smoke run).
_default = ("../supercell_kessler_data_task_0.nc"
            if os.path.exists("../supercell_kessler_data_task_0.nc")
            else "supercell_kessler_data_task_0.nc")
data_path = os.environ.get("MWML_DATASET", _default)
inputs, outputs, meta = load_dataset(data_path)
print("device", device, "inputs", inputs.shape, "outputs", outputs.shape)"""),
    ("code", """\
# Single-cell inputs = stencil row 0 (the notebook's choice in the
# reference); train_mlp handles the slice + min-max tables internally.
model, scl_in, scl_out, history = train_mlp(
    inputs, outputs, device=device, hidden=10, epochs=10, batch=1024,
    val_split=0.2, seed=0)
print("input scaling table (min, max) per var:")
print(np.asarray(scl_in))
print("output scaling table:")
print(np.asarray(scl_out))"""),
    ("code", """\
for h in history:
    print(f"epoch {h['epoch']:2d}  train mse {h['loss']:.3e}"
          f"  val mse {h['val_loss']:.3e}")"""),
    ("code", """\
# Quick skill check: denormalized predictions vs truth on the val tail.
x = inputs[:, :, 0] if inputs.ndim == 3 else inputs
n_val = max(1, int(0.2 * x.shape[0]))
xv, yv = x[-n_val:], outputs[-n_val:]
with torch.no_grad():
    pred = denormalize(model(normalize(torch.as_tensor(xv, device=device),
                                       scl_in)), scl_out)
err = np.abs(pred.cpu().numpy() - yv).mean(axis=0)
names = ["temp", "rho_v", "rho_c", "rho_p"]
for nm, e, sd in zip(names, err, yv.std(axis=0)):
    print(f"{nm:6s} mean |err| {e:.3e}   (truth std {sd:.3e})")"""),
    ("code", """\
# Export for the online surrogate micro (same artifact set a Keras/ponni
# export provides: weights + the two min-max text tables).
from miniweatherml_tpu_torch.ml.mlp import save_mlp, save_scaling

prefix = os.environ.get("MWML_OUT_PREFIX", "kessler_surrogate_example")
save_mlp(prefix + "_weights.npz", model)
save_scaling(prefix + "_scl_in.txt", scl_in)
save_scaling(prefix + "_scl_out.txt", scl_out)
print("wrote", prefix + "_{weights.npz,scl_in.txt,scl_out.txt}")"""),
    ("md", """\
Deploy online by pointing the inference driver at the artifacts
(reference: `inference_ponni.cpp` + `microphysics_kessler_ponni.h`):

```yaml
# in the experiment YAML
nn_weights:        kessler_surrogate_example_weights.npz
nn_input_scaling:  kessler_surrogate_example_scl_in.txt
nn_output_scaling: kessler_surrogate_example_scl_out.txt
surrogate_online:  true
```

```
python -m miniweatherml_tpu_torch inference_surrogate <your.yaml> [--device cpu]
```

With `surrogate_compare: true` the driver also runs the real Kessler and
prints the mean NN−truth differences each step, like the reference's
`microphysics_kessler_ponni.h:244-269`.  The cell below does the same
hand-off in process: it loads the exported artifacts through
`surrogate_from_config` and runs one step of the 2-D supercell with the
trained model deployed online."""),
    ("code", """\
from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import inference_surrogate

config = config_from_dict(dict(
    sim_time=10.0, nens=1, nx_glob=32, ny_glob=1, nz=16, xlen=100000.0,
    ylen=100000.0, zlen=20000.0, init_data="supercell", out_prefix="nb",
    dt_phys=0.0, out_freq=-1.0, nn_weights=prefix + "_weights.npz",
    nn_input_scaling=prefix + "_scl_in.txt",
    nn_output_scaling=prefix + "_scl_out.txt",
    surrogate_online=True, surrogate_compare=True))
micro = inference_surrogate.surrogate_from_config(config)
state, mods, dycore = inference_surrogate.build(config, device, micro=micro)
dt = dycore.compute_time_step(state)
for mod in mods:
    state = mod(state, dt)
problems = state.validate()
assert not problems, problems
print("one online step: mean diff NN - Kessler [temp, rho_v, rho_c, rho_r]:",
      state["surrogate_diffs"].tolist())"""),
]

NOTEBOOKS = {"torch_kessler_netcdf_to_numpy.ipynb": ("curate", CURATE),
             "torch_kessler_singlecell_train_example.ipynb": ("train", TRAIN)}


def main(out_dir: str = OUT) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for fname, (name, cells) in NOTEBOOKS.items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            nbf.write(notebook(name, cells), f)
        print("wrote", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()

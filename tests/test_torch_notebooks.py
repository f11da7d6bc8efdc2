"""The port's surrogate-workflow notebooks (``notebooks/torch_*.ipynb``,
written by ``scripts/make_torch_notebooks.py``) against their builder and
against the JAX package's notebooks.

Both pairs of notebooks are executed with nbclient, on the CPU, on the
sample harvest at the repo root, each in a working directory of its own:
the port's curation notebook must write a ``kessler_dataset.npz`` equal,
array for array, to the JAX notebook's (the same seeded numpy shuffle), and
the port's training notebook must export scaling tables equal to the JAX
notebook's bit for bit (both are min-max tables of the same numpy rows);
the port's exported weights must load through ``surrogate_from_config``
and run a step.  The four notebooks execute once for the file (~30 s).
"""

import importlib.util
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.config import config_from_dict
from miniweatherml_tpu_torch.experiments import inference_surrogate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_DIR = os.path.join(REPO, "notebooks")
SAMPLE = "supercell_kessler_data_task_0.nc"
CURATE = ("kessler_netcdf_to_numpy.ipynb",
          "torch_kessler_netcdf_to_numpy.ipynb")
TRAIN = ("kessler_singlecell_train_example.ipynb",
         "torch_kessler_singlecell_train_example.ipynb")
PORT_NOTEBOOKS = (CURATE[1], TRAIN[1])


def _builder():
    spec = importlib.util.spec_from_file_location(
        "make_torch_notebooks",
        os.path.join(REPO, "scripts", "make_torch_notebooks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_builder_reproduces_the_notebooks(tmp_path):
    paths = _builder().main(str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        PORT_NOTEBOOKS)
    for p in paths:
        with open(p) as a, open(os.path.join(NB_DIR, os.path.basename(p))) as b:
            assert a.read() == b.read(), p


_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|miniweatherml_tpu)\b(?!_torch)|\bjnp\.|"
    r"miniweatherml_tpu\.(?!_torch)", re.M)


@pytest.mark.parametrize("name", PORT_NOTEBOOKS)
def test_no_cell_uses_jax(name):
    with open(os.path.join(NB_DIR, name)) as f:
        nb = json.load(f)
    code = ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]
    assert code and not any(_JAX_IMPORT.search(src) for src in code)
    assert any("miniweatherml_tpu_torch.ml" in src for src in code)


def _execute(name, work):
    import nbclient
    import nbformat

    shutil.copy(os.path.join(NB_DIR, name), work / name)
    shutil.copy(os.path.join(REPO, SAMPLE), work / SAMPLE)
    with pytest.MonkeyPatch.context() as mp:
        # the kernel is a fresh interpreter: the repo on its path, the JAX
        # package and the port on the CPU, inputs and outputs in ``work``
        mp.setenv("PYTHONPATH", REPO)
        mp.setenv("MWML_PLATFORM", "cpu")
        mp.setenv("MWML_DEVICE", "cpu")
        mp.setenv("MWML_DATA_DIR", str(work))
        mp.setenv("MWML_DATASET", str(work / SAMPLE))
        mp.setenv("MWML_OUT_PREFIX", str(work / "nbtest"))
        doc = nbformat.read(str(work / name), as_version=4)
        nbclient.NotebookClient(
            doc, timeout=600, kernel_name="python3",
            resources={"metadata": {"path": str(work)}}).execute()
    return doc


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """Each of the four notebooks executed in a directory of its own:
    name -> (directory, executed notebook)."""
    pytest.importorskip("nbclient")
    out = {}
    for name in CURATE + TRAIN:
        work = tmp_path_factory.mktemp(name.split(".")[0])
        out[name] = (work, _execute(name, work))
    return out


def test_curated_dataset_equals_the_jax_notebook_s(executed):
    jax_npz, port_npz = (executed[n][0] / "kessler_dataset.npz"
                         for n in CURATE)
    with np.load(jax_npz) as a, np.load(port_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"inputs", "outputs"} <= set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b["inputs"].shape[1:] == (5, 2) and len(b["inputs"]) > 0


def test_scaling_tables_equal_the_jax_notebook_s(executed):
    for table in ("_scl_in.txt", "_scl_out.txt"):
        jax_txt, port_txt = (executed[n][0] / ("nbtest" + table)
                             for n in TRAIN)
        assert port_txt.read_text() == jax_txt.read_text(), table
        np.testing.assert_array_equal(np.loadtxt(port_txt),
                                      np.loadtxt(jax_txt))


def test_exported_weights_deploy(executed):
    work, doc = executed[TRAIN[1]]
    assert "one online step" in "".join(
        o.get("text", "") for o in doc.cells[-1].outputs)
    prefix = str(work / "nbtest")
    cfg = config_from_dict(dict(
        sim_time=10.0, nens=1, nx_glob=16, ny_glob=1, nz=12, xlen=100000.0,
        ylen=100000.0, zlen=20000.0, init_data="supercell", out_prefix="t",
        dt_phys=0.0, out_freq=-1.0, nn_weights=prefix + "_weights.npz",
        nn_input_scaling=prefix + "_scl_in.txt",
        nn_output_scaling=prefix + "_scl_out.txt", surrogate_online=True))
    micro = inference_surrogate.surrogate_from_config(cfg)
    assert [tuple(w.shape) for w, _ in micro.model.weights] == [(5, 10),
                                                                (10, 4)]
    state, mods, dycore = inference_surrogate.build(cfg, "cpu", micro=micro)
    dt = dycore.compute_time_step(state)
    for mod in mods:
        state = mod(state, dt)
    assert state.validate() == {}
    assert torch.isfinite(state["temp"]).all()

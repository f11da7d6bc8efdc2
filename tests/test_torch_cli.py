"""The port's command-line entry points run on the GPU unless asked for the
CPU: without CUDA they raise, naming ``--device cpu``, and with it they run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from miniweatherml_tpu_torch.__main__ import main as cli_main
from miniweatherml_tpu_torch.experiments import (community_benchmark,
                                                 gather_statistics,
                                                 generate_micro_data,
                                                 inference_surrogate,
                                                 simple_city,
                                                 supercell_example,
                                                 supercell_p3)
from miniweatherml_tpu_torch.ml import train
from miniweatherml_tpu_torch.ml.mlp import MLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "inputs", "examples")

SUPERCELL = ("nx_glob: 12\nny_glob: 2\nnz: 12\nxlen: 40000.0\n"
             "ylen: 40000.0\nzlen: 16000.0\ninit_data: supercell\n"
             "out_freq: -1.0\nsim_time: 2.0\n")
BUILDING = ("nx_glob: 24\nny_glob: 16\nnz: 10\nxlen: 2000.0\nylen: 2000.0\n"
            "zlen: 500.0\ninit_data: building\nout_freq: -1.0\n"
            "enable_gravity: false\nsim_time: 0.05\n")

SURROGATE = SUPERCELL + (
    f"nn_weights: {EX}/supercell_kessler_example_weights.npz\n"
    f"nn_input_scaling: {EX}/supercell_kessler_input_scaling.txt\n"
    f"nn_output_scaling: {EX}/supercell_kessler_output_scaling.txt\n"
    "surrogate_online: true\n")

# name -> (main, input YAML; None: a small .npz training dataset)
MAINS = {"supercell_example": (supercell_example.main, SUPERCELL),
         "supercell_p3": (supercell_p3.main, SUPERCELL),
         "simple_city": (simple_city.main, BUILDING),
         "community_benchmark": (community_benchmark.main, SUPERCELL),
         "inference_surrogate": (inference_surrogate.main, SURROGATE),
         "gather_statistics": (gather_statistics.main, SUPERCELL),
         "generate_micro_data": (generate_micro_data.main, SUPERCELL),
         "ml.train": (train.main, None)}


def _input(yaml, tmp_path):
    if yaml is None:
        path = tmp_path / "data.npz"
        rng = np.random.default_rng(0)
        np.savez(path, inputs=rng.random((300, 5, 2), np.float32),
                 outputs=rng.random((300, 4), np.float32))
    else:
        path = tmp_path / "input.yaml"
        path.write_text(yaml + f"out_prefix: {tmp_path / 'out'}\n")
    return path


@pytest.mark.parametrize("name", sorted(MAINS))
def test_entry_point_needs_cuda_unless_asked_for_cpu(name, tmp_path,
                                                     monkeypatch):
    main, yaml = MAINS[name]
    path = _input(yaml, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([str(path)])
    out = main([str(path), "--device", "cpu"])
    result = out[0] if isinstance(out, tuple) else out
    if isinstance(result, MLP):
        assert all(p.device.type == "cpu" for p in result.parameters())
        result.validate()
    else:
        assert result.device.type == "cpu"
        assert result.validate() == {}


def test_cli_lists_experiments():
    """python -m miniweatherml_tpu_torch --list names all seven experiments
    and the training module."""
    out = subprocess.run([sys.executable, "-m", "miniweatherml_tpu_torch",
                          "--list"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    for name in ("supercell_example", "community_benchmark", "simple_city",
                 "supercell_p3", "gather_statistics", "generate_micro_data",
                 "inference_surrogate"):
        assert f"  {name} " in out.stdout
    assert "python -m miniweatherml_tpu_torch.ml.train" in out.stdout


def test_cli_dispatches_an_experiment(tmp_path, monkeypatch, capsys):
    """python -m miniweatherml_tpu_torch <experiment> <yaml> --device cpu
    runs the experiment's main on the rest of the command line."""
    monkeypatch.chdir(tmp_path)
    path = _input(SUPERCELL, tmp_path)
    state = cli_main(["supercell_example", str(path), "--device", "cpu"])
    assert state.device.type == "cpu" and state.validate() == {}
    assert "simulation_loop" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown experiment"):
        cli_main(["no_such_experiment", str(path)])
